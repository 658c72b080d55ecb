"""The encode kernels' byte model, counted from the configuration's
shapes: the calls of a frame's steps and the table rows they can reach."""

from slambench import check, harness, yardstick as Y

SPEC = harness.cell_files(harness.ROOT, "replica_room0", "seq")
CFG = SPEC["config"]["config"]


def test_a_tracking_frame_encodes_its_rays_once_an_iteration():
    calls = Y.frame_encode_calls(CFG, 11)
    n = CFG["tracking"]["sample"] * Y.samples_per_ray(CFG)
    assert calls == [("fwd", n), ("bwd", n, False, True)] * 10


def test_a_ba_frame_adds_its_rays_and_the_lattice():
    calls = Y.frame_encode_calls(CFG, 125)[20:]
    # 25 keyframes: 2048 sampled rays and the current frame's 100.
    nb = (2048 + 100) * Y.samples_per_ray(CFG)
    assert calls == [("fwd", nb), ("bwd", nb, True, True),
                     ("fwd", 31 ** 3), ("bwd", 31 ** 3, True, False)] * 10


def test_reached_rows_stop_at_each_level():
    spec = check.model_spec(CFG)
    assert sum(Y.level_rows(spec)) == spec.total_entries
    assert Y.reach_rows(spec, 1) == 8 * spec.n_levels
    assert Y.reach_rows(spec, 10 ** 6) == spec.total_entries
