"""The port's row accumulate (coslam_torch.ops.serial_scatter and
hash_pallas.scatter_add) against the JAX package's Pallas K3 and K4 in
interpret mode and a serial np.add.at.

Tolerance: none. The plain version (the CPU path of both modes, and the
oracle of kernels F and H) adds every row's updates in increasing update
order from 0.0, as the TPU's serial loops and np.add.at do, so all three
agree bit for bit, out-of-range and negative indices included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import hash_pallas as JHP
from coslam_tpu.ops import serial_scatter as JSS
from coslam_torch.ops import hash_pallas as THP
from coslam_torch.ops import serial_scatter as TSS
from test_torch_kernels_card import ADVERSARIAL, adversarial_stream

torch.set_num_threads(1)


def _updates(m, rows, width, seed):
    """idx over [-5, rows + 5): negatives and indices past the slack row;
    a third of the updates on 3 hot rows. Values unit normal."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-5, rows + 5, m).astype(np.int32)
    idx[: m // 3] = rng.integers(0, 3, m // 3)
    rng.shuffle(idx)
    return idx, rng.standard_normal((m, width)).astype(np.float32)


def _np_add_at(idx, vals, rows):
    out = np.zeros((rows + 1, vals.shape[1]), np.float32)
    np.add.at(out, np.clip(idx, 0, rows), vals)
    return out


@pytest.mark.parametrize("width", [1, 2, 4, 16])
def test_row_accum_equals_np_add_at_and_row_accum_mat(width):
    """Both modes' plain version = serial np.add.at = row_accum_mat in
    interpret mode (K3), bit for bit, slack row included."""
    rows = 300
    idx, vals = _updates(10_000, rows, width, seed=width)
    ref = _np_add_at(idx, vals, rows)
    for det in (True, False):
        out = TSS.row_accum(torch.from_numpy(idx), torch.from_numpy(vals),
                            rows, det).numpy()
        np.testing.assert_array_equal(out, ref)
    k3 = JSS.row_accum_mat(jnp.asarray(idx), jnp.asarray(vals), rows,
                           interpret=True)
    np.testing.assert_array_equal(np.asarray(k3), ref)


def test_row_accum_stream_form_equals_k3():
    """K3's stream-list wrapper row_accum (W 1-D streams stacked) gives
    the same bits as the port's [M, W] form."""
    rows = 257
    idx, vals = _updates(5_000, rows, 2, seed=9)
    k3 = JSS.row_accum(jnp.asarray(idx), (jnp.asarray(vals[:, 0]),
                                          jnp.asarray(vals[:, 1])), rows,
                       interpret=True)
    out = TSS.row_accum(torch.from_numpy(idx), torch.from_numpy(vals), rows,
                        True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(k3))


@pytest.mark.parametrize("deterministic", [True, False])
def test_scatter_add_equals_scatter_add_pallas(deterministic):
    """scatter_add = K4 (scatter_add_pallas, interpret mode) bit for bit:
    negative indices add into row 0, indices >= n_rows are dropped."""
    n_rows = 300
    idx, vals = _updates(10_000, n_rows, 2, seed=11)
    k4 = JHP.scatter_add_pallas(jnp.asarray(idx), (jnp.asarray(vals[:, 0]),
                                                   jnp.asarray(vals[:, 1])),
                                n_rows, interpret=True)
    out = THP.scatter_add(torch.from_numpy(idx), torch.from_numpy(vals),
                          n_rows, deterministic).numpy()
    assert out.shape == (n_rows, 2)
    np.testing.assert_array_equal(out, np.asarray(k4))
    np.testing.assert_array_equal(out, _np_add_at(idx, vals, n_rows)[:n_rows])


def test_scatter_add_grouped_drops_negatives():
    """The JAX package's two K4 callers differ on negative indices
    (reference behaviour, not a fault of the port): scatter_add_pallas
    clips them into row 0, scatter_add_grouped (tables of over 64 Ki
    rows, one pass per row range) sends them to a pass's slack row and
    drops them. The port follows scatter_add_pallas."""
    n_rows = 65_536 + 100
    idx = np.array([-1, -7, 0, 5, 65_600, n_rows, n_rows + 3], np.int32)
    vals = np.arange(1, 15, dtype=np.float32).reshape(7, 2)
    grouped = np.asarray(JHP.scatter_add_grouped(
        jnp.asarray(idx), jnp.asarray(vals), n_rows, interpret=True))
    out = THP.scatter_add(torch.from_numpy(idx), torch.from_numpy(vals),
                          n_rows, True).numpy()
    np.testing.assert_array_equal(grouped[0], vals[2])
    np.testing.assert_array_equal(out[0], vals[0] + vals[1] + vals[2])
    np.testing.assert_array_equal(out[1:], grouped[1:])


def test_empty_update_list_gives_zeros():
    out = TSS.row_accum(torch.empty(0, dtype=torch.int32),
                        torch.empty((0, 3)), 4, True)
    assert torch.equal(out, torch.zeros((5, 3)))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to a kernel or the call raises: meta
    tensors, an int64 index on the card's path, and a [M] value vector
    raise; no launch is counted."""
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    vals = torch.empty((4, 2), device="meta")
    for det in (True, False):
        with pytest.raises(ValueError):
            TSS.row_accum(idx, vals, 9, det)
        with pytest.raises(ValueError):
            TSS.row_accum(idx.long(), vals, 9, det)
        with pytest.raises(ValueError):
            TSS.row_accum(idx, vals[:, 0], 9, det)
    assert TSS.row_accum_atomic.launches == 0
    assert TSS.row_accum_segmented.launches == 0


# Kernel H's adversarial streams (shared with its card test) on the plain
# path: the oracle the card test holds kernel H to must itself equal the
# TPU's serial order.


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_deterministic_plain_path_on_adversarial_streams(name):
    """row_accum(..., deterministic=True) on the CPU = serial np.add.at =
    K4 (scatter_add_pallas, interpret mode; tables within its 64 Ki VMEM
    rows) bit for bit: one row taking every update, a run longer than a
    tile, runs across tile boundaries, indices below 0 and above rows,
    M = 1, rows = 0, an empty stream and a 3-pass table."""
    idx, vals, rows = adversarial_stream(name, 2)
    out = TSS.row_accum(torch.from_numpy(idx), torch.from_numpy(vals), rows,
                        True).numpy()
    np.testing.assert_array_equal(out, _np_add_at(idx, vals, rows))
    if idx.shape[0] and rows <= 65_536:
        k4 = JHP.scatter_add_pallas(jnp.asarray(idx), (jnp.asarray(vals[:, 0]),
                                                       jnp.asarray(vals[:, 1])),
                                    rows, interpret=True)
        np.testing.assert_array_equal(out[:rows], np.asarray(k4))


@pytest.mark.parametrize("rows,bits,passes", [
    (0, 1, 1), (1, 1, 1), (127, 7, 1), (128, 4, 2), (300, 5, 2),
    (834_097, 7, 3), (3_000_000, 6, 4), (2 ** 31 - 2, 7, 5)])
def test_sort_plan_covers_the_keys_in_few_even_passes(rows, bits, passes):
    """Kernel H sorts keys in [0, rows] over the bits rows needs, in the
    fewest passes of at most 7 bits (room0_xor's 834,097 rows: 3 of 7)."""
    plan = TSS.sort_plan(rows)
    assert (plan.digit_bits, plan.passes) == (bits, passes)
    assert plan.digit_bits <= TSS.SORT_MAX_DIGIT_BITS
    assert rows < 2 ** (plan.digit_bits * plan.passes)
    assert plan.digit_bits * (plan.passes - 1) < max(rows.bit_length(), 1)


@pytest.mark.parametrize("width", [2, 3])
@pytest.mark.parametrize("rows", [300, 1024, 3_000_000])
def test_segmented_plan_scratch_layout(rows, width):
    """Kernel H's scratch: one int32 allocation split, without overlap,
    into two key buffers of M (each 16-byte aligned), a published count
    per sort tile and digit and the ticket, the digit counts of every
    pass, rows + 2 run starts and the walk's count and list of long runs
    (rows + 2); two payload buffers of the value rows (W = 2, float32
    [M, 2]) or of m (int32 [M]), each 16-byte aligned; the sorted keys
    and payloads where the last pass writes them (buffer a after an odd
    count of passes)."""
    m = 5001
    h = TSS.SegmentedPlan(torch.zeros(m, dtype=torch.int32),
                          torch.zeros((m, width)), rows)
    tiles = -(-m // TSS.SORT_TILE)
    parts = (h.keys_a, h.keys_b, h.status, h.digit_total, h.start,
             h.long_rows)
    assert [p.numel() for p in parts] == [
        m, m, tiles * h.plan.radix + 1, h.plan.passes * h.plan.radix,
        rows + 2, rows + 2]
    offsets = [p.storage_offset() for p in parts]
    assert offsets == sorted(offsets)
    assert offsets[0] % 4 == 0 and offsets[1] % 4 == 0     # 16-byte aligned
    assert offsets[1] >= offsets[0] + m and offsets[2] >= offsets[1] + m
    assert all(p.dtype == torch.int32 and p.is_contiguous() for p in parts)
    assert h.carry == (width == 2)
    for pay in (h.pay_a, h.pay_b):
        assert pay.is_contiguous() and pay.data_ptr() % 16 == 0
        assert ((pay.dtype, tuple(pay.shape)) == (torch.float32, (m, 2))
                if h.carry else (pay.dtype, tuple(pay.shape))
                == (torch.int32, (m,)))
    odd = h.plan.passes % 2 == 1
    assert h.keys is (h.keys_a if odd else h.keys_b)
    assert h.pay is (h.pay_a if odd else h.pay_b)
