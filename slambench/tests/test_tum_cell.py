"""The TUM fr1/desk cell ``tum.seq`` as the committed BENCHMARK.json has
it: its entries beside room0's (which stay as they were), the tiny TUM
cell traced on the CPU under the configuration's own limits, the faults
the cell can have each coming out not correct under those limits, and
the readers of the spans the recipe adds (``ba_fine_ms``,
``mesh_job_ms``) on hand-made runs."""

import json
import os
import time

import pytest

from slambench import harness
from slambench.tests import tiny
from slambench.tests.test_faults import _ba_unchanged, _track_unchanged

CONFIG, CELL = "tum_fr1_desk", "tum.seq"
ROOM0 = ["loop_self_ms", "track_ms", "ba_ms.p95", "launches_per_frame",
         "kernA_roofline", "kernB_roofline", "step_mfu_pct",
         "device_idle_pct", "track_fwd_ms", "track_bwd_ms",
         "track_update_ms", "track_wait_ms", "ba_fwd_ms", "ba_bwd_ms",
         "ba_update_ms", "ba_wait_ms", "frame_block_ms", "load_wait_ms",
         "first_frame_s", "track_graphed_pct"]
NEW = ["ba_fine_ms", "mesh_job_ms"]
ROOFLINES = {"kernA_roofline.tum", "kernB_roofline.tum"}


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _tum_twin(m):
    """The TUM cell's own entry for room0's entry ``m``: what moves room0's
    frame tail (an end-to-end metric of room0's alone) moves ``fps`` here,
    since every 5th frame carries its BA in the sequential loop."""
    moves = "fps" if m["moves"] == "frame_ms_p95" else m["moves"]
    return dict(m, name=m["name"] + ".tum", workloads=[CELL], moves=moves)


def test_committed_benchmark_holds_the_tum_cell_beside_room0():
    b = _bench()
    cfg = next(c for c in b["configs"] if c["name"] == CONFIG)
    assert cfg["file"] == f"slambench/configs/{CONFIG}.json"
    assert cfg["reduced"] == ["data"]
    wl = next(w for w in b["workloads"] if w["name"] == CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (CONFIG, "seq", 1)

    room0 = harness.cell_spec(harness.ROOT, "room0.seq")
    assert [m["name"] for m in room0["end_to_end"]] == [
        "fps", "frame_ms_p95", "setup_s"]
    assert [m["name"] for m in room0["per_layer"]] == ROOM0
    for m in room0["per_layer"]:
        assert m["workloads"] == ["room0.seq"]

    # The cell adds no end-to-end metric: it reports the two every cell
    # reports.
    tum = harness.cell_spec(harness.ROOT, CELL)
    assert [m["name"] for m in b["end_to_end"]] == [
        "fps", "frame_ms_p95", "setup_s"]
    assert [m["name"] for m in tum["end_to_end"]] == ["fps", "setup_s"]
    names = [m["name"] for m in tum["per_layer"]]
    assert names == [n + ".tum" for n in ROOM0] + NEW
    twins = {m["name"]: m for m in tum["per_layer"]}
    for m in room0["per_layer"]:
        assert twins[m["name"] + ".tum"] == _tum_twin(m)
    for name in NEW:
        m = twins[name]
        assert m["workloads"] == [CELL] and m["source"] == "program_span"
        assert m["moves"] in {x["name"] for x in tum["end_to_end"]}
    for m in tum["end_to_end"] + tum["per_layer"]:
        assert callable(harness.reader(m["name"]))


# The numbers that do not part the program from the TF32 + bfloat16
# control in this recipe and that no planted fault moves: not compared.
NOT_HELD = {"ba_loss0", "ff_loss0"}


def test_the_cell_is_held_to_its_own_limits():
    spec = harness.cell_spec(harness.ROOT, CELL)
    own = harness.load_json(os.path.join(harness.ROOT, "slambench",
                                         "limits", f"{CONFIG}.json"))
    room0 = harness.load_json(os.path.join(harness.ROOT, "slambench",
                                           "limits", "replica_room0.json"))
    assert spec["limits"] == own and own != room0
    assert set(own) == set(room0) - NOT_HELD


def _tiny_overrides():
    """The tiny TUM cell, with a periodic mesh every 5 frames, so that
    the window's frames before the stretch (11-16) submit one job."""
    ov = tiny.overrides(CONFIG)
    ov["mesh"]["vis"] = 5
    return ov


def _traced_tiny_tum(device):
    """The committed cell's spec and limits, the tiny TUM cell traced on
    ``device``: correct, the fine pass a part of BA's forward, the one
    window job's wall read."""
    spec = harness.cell_spec(harness.ROOT, CELL)
    r = harness.run_cell(CELL, 5, 4.0, True, time.perf_counter(),
                         device=device, overrides=_tiny_overrides(),
                         traffic_overrides=tiny.TRAFFIC,
                         sequence_overrides=tiny.SEQUENCE, spec=spec)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0.0 < m["ba_fine_ms"] < m["ba_fwd_ms.tum"]
    assert m["mesh_job_ms"] > 0.0
    return m, {m["name"] for m in spec["per_layer"]}


def test_traced_tiny_tum_cell_is_correct_and_reports_its_metrics():
    """On the CPU every per-layer entry is reported but the encode
    kernels' rooflines, which read the card's kernels."""
    m, names = _traced_tiny_tum("cpu")
    assert set(m) == names - ROOFLINES


@pytest.mark.cuda
def test_traced_tiny_tum_cell_on_the_card_reports_every_metric(cuda_device):
    """On the card every entry, each roofline share under 100 %."""
    m, names = _traced_tiny_tum("cuda")
    assert set(m) == names
    for name in ROOFLINES:
        assert 0.0 < m[name] < 100.0


def _fine_half(slam):
    """The fine pass with every other importance sample left out."""
    model = slam.model
    fine = model._fine_pass

    def broken(params, rays_o, rays_d, z_vals, raw, weights, u):
        return fine(params, rays_o, rays_d, z_vals, raw, weights,
                    None if u is None else u[:, ::2])

    model._fine_pass = broken


def _fine_strata(slam):
    """The fine pass on the coarse weights' strata (the deterministic
    samples) in place of the draw."""
    model = slam.model
    fine = model._fine_pass

    def broken(params, rays_o, rays_d, z_vals, raw, weights, u):
        return fine(params, rays_o, rays_d, z_vals, raw, weights, None)

    model._fine_pass = broken


@pytest.mark.parametrize("fault,expect", [
    (_track_unchanged, "track_pose"),
    (_ba_unchanged, "ba_change"),
    (_fine_half, "track_loss0"),
    (_fine_strata, "track_loss0"),
])
def test_fault_comes_out_not_correct_under_the_tum_limits(fault, expect):
    spec = harness.cell_spec(harness.ROOT, CELL)
    r = harness.run_cell(CELL, 5, 3.0, False, time.perf_counter(),
                         device="cpu", overrides=tiny.overrides(CONFIG),
                         traffic_overrides=tiny.TRAFFIC,
                         sequence_overrides=tiny.SEQUENCE, spec=spec,
                         hook=fault)
    assert not r["correct"]
    c = r["checks"][expect]
    assert not c["value"] <= c["limit"], r["checks"]


# -- the readers on hand-made runs --------------------------------------------

K0, N = 11, 40
EXCLUDED = range(31, N)


def _value(key, k):
    """A reading that names its key and its entry (s)."""
    return (hash(key) % 97 + 1) * 1e-4 + k * 1e-6


def _run(vis=10, spans=True, jobs=None):
    """Frames [0, N), BA every 5th; with ``spans`` the BA calls'
    mapping.fine sums and the periodic mesh jobs' walls, entry j the job
    of the loop's j-th ``mesh_eval`` event (at frames vis, 2 vis, ...;
    ``jobs``: that many entries in place of one an event)."""
    cfg = {"mapping": {"map_every": 5, "keyframe_every": 5},
           "mesh": {"vis": vis}}
    walls = [100.0 + 0.2 * k for k in range(N + 1)]
    subs = range(vis, N, vis) if vis else ()
    events = [(walls[k] + 0.15, walls[k] + 0.16, "mesh_eval") for k in subs]
    events += [(walls[k] + 0.01, walls[k] + 0.05, "ba")
               for k in range(5, N, 5)]
    t = {"mapping": [_value("mapping", k) for k in range(5, N, 5)]}
    if spans:
        t["mapping.fine"] = [_value("mapping.fine", k)
                             for k in range(5, N, 5)]
        t["mesh_job"] = [_value("mesh_job", k) for k in subs][:jobs]
    return harness.Run(cfg, walls, t, events, K0, N, 3.0, EXCLUDED)


def _mean_ms(key, frames):
    return 1e3 * sum(_value(key, k) for k in frames) / len(frames)


@pytest.mark.parametrize("name", NEW)
def test_absent_span_reads_none(name):
    assert harness.reader(name)(_run(spans=False)) is None


def test_ba_fine_ms_is_the_mean_a_ba_call_before_the_stretch():
    assert harness.reader("ba_fine_ms")(_run()) == pytest.approx(
        _mean_ms("mapping.fine", [15, 20, 25, 30]), rel=1e-12)


@pytest.mark.parametrize("vis,frames", [(10, [20, 30]), (7, [14, 21, 28])])
def test_mesh_job_ms_is_the_mean_of_the_window_jobs(vis, frames):
    """The jobs submitted from the window's frames before the stretch
    (11-30), each by its own event's frame."""
    got = harness.reader("mesh_job_ms")(_run(vis=vis))
    assert got == pytest.approx(_mean_ms("mesh_job", frames), rel=1e-12)


def test_mesh_job_ms_without_a_window_job_reads_none():
    assert harness.reader("mesh_job_ms")(_run(vis=50)) is None
    assert harness.reader("mesh_job_ms")(_run(vis=0)) is None


def test_mesh_job_ms_reads_none_where_jobs_and_events_do_not_pair():
    """A job that raised, or a runtime that times its jobs without the
    loop's events: no entry can be given its frame."""
    assert harness.reader("mesh_job_ms")(_run(jobs=2)) is None
