"""The serial modes' segmented sort (kernels B, D and U in the TPU kernels'
serial order) on the CPU: its plan, its order and its plain version.

On the card the table gradient's updates are produced inside a radix sort
of disjoint row segments (coslam_torch/csrc/serial_sort.cuh): a level of
the packed grid, a plane section of the tri-plane or TensoVM table, and
TensoVM's line table. Held here:

- ``segment_plan`` of each encoder: segments disjoint, covering every row
  an update can reach, with digits that cover every local key in the
  fewest passes of at most 9 bits;
- each module's ``serial_order`` (a permutation of the plain update
  stream: ``*_bwd_streams_ref``) keeps every row's order: its stable sort
  by row is the stream's stable sort element for element, its serial row
  sum is the plain version's table gradient bit for bit, and it agrees
  with the JAX package's table gradient through K2 and K3 in Pallas
  interpret mode within the tolerances of test_torch_hash_grid.py,
  test_torch_triplane.py and test_torch_tensovm.py;
- ``serial_sort_ref``, the kernels' tile, segment and look-back
  arithmetic on the host, equals a stable sort, over 1, 2 and 3 passes.

Inputs come from numpy seeds; everything is float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import hash_packed as JHP
from coslam_tpu.ops import plane_quad as PQ
from coslam_tpu.ops import tensovm as JVM
from coslam_tpu.ops import triplane as JTP
from coslam_torch.ops import hash_packed as HP
from coslam_torch.ops import serial_scatter as SS
from coslam_torch.ops import tensovm as VM
from coslam_torch.ops import triplane as TP
from coslam_torch.tools.bench import _common as C

torch.set_num_threads(1)

# The packed grids: hashed and dense levels (test_torch_hash_grid.py's
# "mixed"), dense only, room0_hybrid's 3 dense levels (16/26/44) and the
# Dense grid at room0's resolution (4 dense levels up to 401^3 rows).
PACKED = {
    "mixed": dict(desired_resolution=64, log2_hashmap_size=13, n_levels=4,
                  base_resolution=16),
    "dense": dict(desired_resolution=24, log2_hashmap_size=16, n_levels=3,
                  base_resolution=12, dense_only=True),
    "hybrid_dense": dict(desired_resolution=44, log2_hashmap_size=16,
                         n_levels=3, base_resolution=16),
    "room0": dict(desired_resolution=400, log2_hashmap_size=16),
    "Dense": dict(desired_resolution=400, n_levels=4, dense_only=True),
}
PLANES = {"small": dict(desired_resolution=96, n_levels=3,
                        base_resolution=16),
          "room0_hybrid": dict(desired_resolution=400, n_levels=4),
          "room0_vm": dict(desired_resolution=400, n_levels=3)}
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)


def _packed(name):
    return HP.make_packed_spec(**PACKED[name])


def _points(n, seed, kind):
    """Uniform points in [-0.05, 1.05], or ray-ordered ones (the samples
    of a ray adjacent, so coarse rows take long runs)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    rays = n // 43
    o = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.standard_normal((rays, 1, 3))
    t = np.linspace(0.0, 0.5, 43)[None, :, None]
    return (o + t * d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(
        -1, 3).astype(np.float32)


def _check_plan(plan, rows):
    """Segments disjoint and covering [0, rows); digits covering each
    segment's local keys in the fewest passes of at most 9 bits, their
    widths at most a bit apart."""
    spans = sorted(zip(plan.lo, plan.hi))
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    widths = plan.pass_bits
    assert 1 <= min(widths) and max(widths) <= SS.SERIAL_MAX_DIGIT_BITS
    assert max(widths) - min(widths) <= 1
    bits = max(plan.bits)
    assert sum(widths) == bits
    assert SS.SERIAL_MAX_DIGIT_BITS * (plan.passes - 1) < bits
    for lo, hi in zip(plan.lo, plan.hi):
        assert hi - lo <= 2 ** sum(widths)
    assert all((plan.packed_bits >> 4 * k) & 15 == b
               for k, b in enumerate(widths))
    tab = plan.table()
    assert tab.shape == (4, len(plan.lo) + 1)
    assert tab[3, -1] == plan.m and tab[2, -1] == sum(plan.tiles)


@pytest.mark.parametrize("name,passes", [
    ("mixed", 2), ("dense", 2), ("hybrid_dense", 2), ("room0", 2),
    ("Dense", 3)])
def test_packed_segment_plan(name, passes):
    """One segment a level, 8 N updates each; room0's largest level (a
    hashed one, 65,936 rows) takes 17 bits in 2 passes (8 and 9 bits),
    the Dense grid's 401^3 level 26 bits in 3 passes."""
    spec = _packed(name)
    plan = HP.serial_segments(spec, 10)
    _check_plan(plan, spec.total_entries)
    assert plan.count == (80,) * spec.n_levels
    assert plan.passes == passes
    if name == "room0":
        assert max(plan.bits) == 17 and plan.pass_bits == (8, 9)
    if name == "Dense":
        assert spec.sizes[-1] == 401 ** 3 and max(plan.bits) == 26
        assert plan.pass_bits == (8, 9, 9)


@pytest.mark.parametrize("name", sorted(PLANES))
@pytest.mark.parametrize("kind", ["triplane", "tensovm"])
def test_plane_segment_plan(kind, name):
    """One segment a plane section ((r + 1)^2 rows, 4 N updates); TensoVM
    adds the line table (2 S N updates) after the planes; room0's 311
    planes (97,344 rows) take 17 bits in 2 passes."""
    spec = TP.make_triplane_spec(**PLANES[name])
    n, S = 10, spec.n_levels
    if kind == "triplane":
        plan, rows = TP.serial_segments(spec, n), spec.total_entries
        assert plan.count == (4 * n,) * S
    else:
        plan = VM.serial_segments(spec, n)
        rows = spec.total_entries + VM.line_total_rows(spec)
        assert plan.count == (4 * n,) * S + (2 * S * n,)
        assert plan.lo[-1] == spec.total_entries
    _check_plan(plan, rows)
    assert plan.passes == 2
    if name != "small":
        assert max(plan.bits) == 17


def _packed_case(name, n, seed, kind):
    spec = _packed(name)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((spec.total_entries, 2)).astype(np.float32)
    x = _points(n, seed, kind)
    g = rng.standard_normal((x.shape[0], spec.out_dim)).astype(np.float32)
    t, tx, tg = (torch.from_numpy(a) for a in (table, x, g))
    idx, vals = HP.grid_encode_bwd_streams_ref(spec, t, tx, tg)
    ref = HP.grid_encode_bwd_ref(spec, t, tx, tg, True, False)[0]
    return (spec, HP.serial_segments(spec, x.shape[0]),
            HP.serial_order(spec, x.shape[0]), idx, vals, ref,
            spec.total_entries, (table, x, g))


def _plane_case(kind, name, n, seed, points):
    spec = TP.make_triplane_spec(**PLANES[name])
    rng = np.random.default_rng(seed)
    x = _points(n, seed, points)
    n = x.shape[0]
    planes = (0.1 * rng.standard_normal((spec.total_entries, 2))).astype(
        np.float32)
    g = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    if kind == "triplane":
        t, tx, tg = (torch.from_numpy(a) for a in (planes, x, g))
        idx, vals = TP.triplane_encode_bwd_streams_ref(spec, t, tx, tg)
        ref = TP.triplane_encode_bwd_ref(spec, t, tx, tg, True, False)[0]
        return (spec, TP.serial_segments(spec, n), TP.serial_order(spec, n),
                idx, vals, ref, spec.total_entries, (planes, x, g))
    lines = (1.0 + 0.1 * rng.standard_normal(
        (VM.line_total_rows(spec), 2))).astype(np.float32)
    p, l, tx, tg = (torch.from_numpy(a) for a in (planes, lines, x, g))
    idx, vals = VM.tensovm_encode_bwd_streams_ref(spec, p, l, tx, tg)
    dp, dl, _ = VM.tensovm_encode_bwd_ref(spec, p, l, tx, tg, True, True,
                                          False)
    return (spec, VM.serial_segments(spec, n), VM.serial_order(spec, n), idx,
            vals, torch.cat([dp, dl]), spec.total_entries + lines.shape[0],
            (planes, lines, x, g))


CASES = ([("packed", name) for name in ("mixed", "dense", "hybrid_dense")]
         + [(kind, name) for kind in ("triplane", "tensovm")
            for name in ("small", "room0_hybrid")])


def _case(kind, name, points, n=1290, seed=0):
    if kind == "packed":
        return _packed_case(name, n, seed, points)
    return _plane_case(kind, name, n, seed, points)


@pytest.mark.parametrize("points", ["uniform", "rays"])
@pytest.mark.parametrize("kind,name", CASES)
def test_serial_order_keeps_every_rows_order(kind, name, points):
    """The serial sort's order is a permutation of the plain stream whose
    segment s holds its updates at positions [base_s, base_s + count_s),
    all on the segment's rows; its stable sort by row equals the plain
    stream's, element for element; its serial row sum (index_add_ in
    order on the CPU) is the plain version's table gradient bit for
    bit."""
    _, plan, order, idx, vals, ref, rows, _ = _case(kind, name, points)
    m = idx.shape[0]
    assert plan.m == m
    assert torch.equal(order.sort().values, torch.arange(m))
    keys, v = idx[order], vals[order]
    base = plan.table()[3]
    for s, (lo, hi) in enumerate(zip(plan.lo, plan.hi)):
        seg = keys[base[s]:base[s + 1]]
        assert int(seg.min()) >= lo and int(seg.max()) < hi
    a = np.argsort(idx.numpy(), kind="stable")
    b = np.argsort(keys.numpy(), kind="stable")
    np.testing.assert_array_equal(keys.numpy()[b], idx.numpy()[a])
    np.testing.assert_array_equal(v.numpy()[b], vals.numpy()[a])
    np.testing.assert_array_equal(SS.row_accum_ref(keys, v, rows)[:rows],
                                  ref)


@pytest.mark.parametrize("points", ["uniform", "rays"])
@pytest.mark.parametrize("kind,name", [("packed", "mixed"),
                                       ("tensovm", "small"),
                                       ("triplane", "room0_hybrid")])
def test_serial_sort_ref_is_the_stable_sort(kind, name, points):
    """The kernels' arithmetic on the host (serial_sort_ref: several
    tiles a segment) over the serially ordered stream: the stream's stable
    sort by row, global rows and values element for element."""
    _, plan, order, idx, vals, _, _, _ = _case(kind, name, points, n=2150)
    assert max(plan.tiles) >= 2
    keys, v = idx[order].numpy(), vals[order].numpy()
    got_k, got_v = SS.serial_sort_ref(plan, keys, v)
    a = np.argsort(idx.numpy(), kind="stable")
    np.testing.assert_array_equal(got_k, idx.numpy()[a])
    np.testing.assert_array_equal(got_v, vals.numpy()[a])


@pytest.mark.parametrize("rows,passes", [(300, 1), (90_000, 2),
                                         (1_000_000, 3)])
def test_serial_sort_ref_passes(rows, passes):
    """1, 2 and 3 passes (segments of up to 2^9, 2^17 and 2^20 rows) on
    random keys with many repeats: the stable sort."""
    rng = np.random.default_rng(rows)
    segs = [(0, rows // 3, 9000), (rows // 3, rows, 5002)]
    plan = SS.segment_plan(segs)
    assert plan.passes == passes
    keys = np.concatenate([rng.integers(lo, lo + max((hi - lo) // 50, 1),
                                        c) for lo, hi, c in segs])
    vals = rng.standard_normal((keys.shape[0], 2)).astype(np.float32)
    got_k, got_v = SS.serial_sort_ref(plan, keys, vals)
    a = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[a])
    np.testing.assert_array_equal(got_v, vals[a])


def test_segment_plan_refuses_odd_or_empty_segments():
    """Every count even (the passes copy value pairs 16 bytes at a time)
    and every segment non-empty."""
    with pytest.raises(ValueError):
        SS.segment_plan([(0, 10, 3)])
    with pytest.raises(ValueError):
        SS.segment_plan([(5, 5, 2)])


def test_packed_serial_order_matches_jax():
    """The serial order's row sum on the mixed grid against the JAX
    package's table gradient through K2 and K3 (make_packed_encode in
    Pallas interpret mode), test_torch_hash_grid.py's tolerance."""
    spec, _, order, idx, vals, _, rows, (table, x, g) = _packed_case(
        "mixed", 129, 1, "uniform")
    js = JHP.make_packed_spec(**PACKED["mixed"])
    enc = JHP.make_packed_encode(js, jnp.float32, interpret=True)
    jd_t = jax.grad(lambda t: jnp.sum(enc(t, jnp.asarray(x))
                                      * jnp.asarray(g)))(jnp.asarray(table))
    got = SS.row_accum_ref(idx[order], vals[order], rows)[:rows]
    np.testing.assert_allclose(got.numpy(), jd_t, **TABLE_TOL)


def test_triplane_serial_order_matches_jax():
    """... on the tri-plane against make_triplane_encode in interpret mode
    (K2's pair scatter), each entry within its sum-order bound
    (test_torch_triplane.py)."""
    spec, _, order, idx, vals, _, rows, (table, x, g) = _plane_case(
        "triplane", "small", 129, 1, "uniform")
    js = JTP.make_triplane_spec(**PLANES["small"])
    enc = JTP.make_triplane_encode(js, jnp.float32, interpret=True)
    jd_t = jax.grad(lambda t: jnp.sum(enc(t, jnp.asarray(x))
                                      * jnp.asarray(g)))(jnp.asarray(table))
    got = SS.row_accum_ref(idx[order], vals[order], rows)[:rows]
    C.assert_within("dtable", got, torch.from_numpy(np.array(jd_t)),
                    C.sum_order_tol(idx, vals, rows)[:rows])


def test_tensovm_serial_order_matches_jax():
    """... on TensoVM: dplanes against plane_quad.quad_table_grad through
    the Pallas row accumulate (K3, interpret mode) and dlines against
    autodiff of the gather oracle, test_torch_tensovm.py's tolerance."""
    spec, _, order, idx, vals, _, rows, (planes, lines, x, g) = _plane_case(
        "tensovm", "small", 129, 2, "uniform")
    js = JVM.make_tensovm_spec(**PLANES["small"])
    n, L = x.shape[0], js.pyr_levels
    got = SS.row_accum_ref(idx[order], vals[order], rows)[:rows].numpy()
    tp = spec.total_entries
    line_f = JVM.line_eval_fwd_only(js, jnp.asarray(lines), jnp.asarray(x))
    gs = jnp.repeat(jnp.asarray(g).reshape(n, L, 2).transpose(2, 1, 0), 3,
                    axis=1) * line_f
    cu, cv, wu, wv = PQ._cell_project(js, jnp.asarray(x))
    dp = PQ.quad_table_grad(js, cu, cv, wu, wv, gs, interpret=True,
                            mm_rcut=0)
    np.testing.assert_allclose(got[:tp], dp, **TABLE_TOL)

    def f(p):
        return jnp.sum(JVM.tensovm_encode_fwd_only(js, p, jnp.asarray(x))
                       * jnp.asarray(g))

    dl = jax.grad(f)({"planes": jnp.asarray(planes),
                      "lines": jnp.asarray(lines)})["lines"]
    np.testing.assert_allclose(got[tp:], dl, **TABLE_TOL)


def _trace(device_events: list) -> list:
    """A chrome trace of three calls in PHASE_RANGE ranges [0, 100),
    [100, 200), [200, 300) on the host, each issuing two launches
    (correlation ids 10c + 1 and 10c + 2 at host time 100c + 10 and + 20),
    plus a launch outside every range (id 99); device_events: (id, name,
    ts, dur) of the device side."""
    from coslam_torch.tools.kernel_times import PHASE_RANGE

    events = [{"name": PHASE_RANGE, "cat": "user_annotation",
               "ts": 100 * c, "dur": 99} for c in range(3)]
    events += [{"name": "cudaLaunchKernel", "cat": "cuda_runtime",
                "ts": 100 * c + 10 * j, "dur": 2,
                "args": {"correlation": 10 * c + j}}
               for c in range(3) for j in (1, 2)]
    events.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime",
                   "ts": 400, "dur": 2, "args": {"correlation": 99}})
    events += [{"name": name, "cat": "kernel", "ts": ts, "dur": dur,
                "args": {"correlation": cid}}
               for cid, name, ts, dur in device_events]
    return events


def _launches(calls, durs=(3.0, 5.0)):
    """Each call's two device events: 'void ns::(anonymous
    namespace)::histogram(int*)' then 'Memset (Device)', `durs` long."""
    return [ev for c in calls for ev in (
        (10 * c + 1, "void ns::(anonymous namespace)::histogram(int*)",
         100 * c + 12, durs[0] + c),
        (10 * c + 2, "Memset (Device)", 100 * c + 30, durs[1]))]


@pytest.mark.parametrize("case", ["all", "one_lost", "none", "outside"])
def test_trace_phases_reads_each_launch_or_nothing(case):
    """kernel_times.trace_phases (the serial modes' phases on the card,
    from a torch.profiler trace): each launch's median device time in
    launch order and the median span, over the calls with the most common
    non-zero launch count; None, so that the phases read "not measured",
    where no call has a device event (a trace in which CUPTI recorded
    nothing, or only launches outside the calls)."""
    from coslam_torch.tools.kernel_times import trace_phases

    device = {"all": _launches(range(3)),
              "one_lost": _launches([0, 2]),
              "none": [],
              "outside": [(99, "stray", 402, 1.0)]}[case]
    got = trace_phases(_trace(device))
    if case in ("none", "outside"):
        assert got is None
        return
    calls = [0, 1, 2] if case == "all" else [0, 2]
    assert got["calls"] == len(calls)
    assert got["phases"] == [["void ns::histogram",
                              float(np.median([3.0 + c for c in calls]))],
                             ["memset", 5.0]]
    assert got["span_us"] == 23.0
