"""The per-layer metrics read from the program's own spans (the readers
of slambench/phases.py): each on a hand-made run, None where the
program has no such span, else the right mean over the window's frames
before the traced stretch; and all eleven in a traced run of the tiny
cell on the CPU, the phases within their step."""

import time

import pytest

from slambench import harness
from slambench.tests import tiny

CFG = {"mapping": {"map_every": 5, "keyframe_every": 5},
       "mesh": {"vis": 50}}
K0, N = 11, 40
EXCLUDED = range(31, N)
TRACK = {"track_fwd_ms": "tracking.forward",
         "track_bwd_ms": "tracking.backward",
         "track_update_ms": "tracking.update",
         "track_wait_ms": "tracking.wait"}
BA = {"ba_fwd_ms": "mapping.forward", "ba_bwd_ms": "mapping.backward",
      "ba_update_ms": "mapping.update", "ba_wait_ms": "mapping.wait"}
NEW = list(TRACK) + list(BA) + ["frame_block_ms", "load_wait_ms",
                                "first_frame_s"]


def _value(key, k):
    """A reading that names its key and frame (s)."""
    return (hash(key) % 97 + 1) * 1e-4 + k * 1e-6


def _timings(with_spans):
    """The loop's timings over frames [0, N): tracking entry k - 1 for
    frame k, BA entry k // 5 - 1 for frame k, the load wait and frame
    block entry k for frame k; with_spans: the program's spans too."""
    t = {"first_frame": [1.0], "mesh": [],
         "tracking": [_value("tracking", k) for k in range(1, N)],
         "mapping": [_value("mapping", k) for k in range(5, N, 5)]}
    if with_spans:
        for key in TRACK.values():
            t[key] = [_value(key, k) for k in range(1, N)]
        for key in BA.values():
            t[key] = [_value(key, k) for k in range(5, N, 5)]
        for key in ("load_wait", "frame_block"):
            t[key] = [_value(key, k) for k in range(N)]
        for p in ("forward", "backward", "update", "wait"):
            t[f"first_frame.{p}"] = [0.25]
    return t


def _run(with_spans):
    walls = [100.0 + 0.2 * k for k in range(N + 1)]
    return harness.Run(CFG, walls, _timings(with_spans), [], K0, N, 3.0,
                       EXCLUDED)


def _mean_ms(key, frames):
    return 1e3 * sum(_value(key, k) for k in frames) / len(frames)


@pytest.mark.parametrize("name", NEW)
def test_absent_span_reads_none(name):
    assert harness.reader(name)(_run(False)) is None


@pytest.mark.parametrize("name", NEW)
def test_mean_over_the_window_before_the_stretch(name):
    run = _run(True)
    frames = list(range(K0, 31))
    ba_frames = [15, 20, 25, 30]
    assert run.frames() == frames and run.ba_frames() == ba_frames
    want = (_mean_ms(TRACK[name], frames) if name in TRACK
            else _mean_ms(BA[name], ba_frames) if name in BA
            else _mean_ms("frame_block", ba_frames)
            if name == "frame_block_ms"
            else _mean_ms("load_wait", frames) if name == "load_wait_ms"
            else 1.0)
    assert harness.reader(name)(run) == pytest.approx(want, rel=1e-12)


def test_traced_tiny_run_reports_every_span_metric():
    """The tiny cell, traced on the CPU, with the eleven metrics beside
    track_ms and ba_ms.p95: each is read, and each step's phases add up
    to no more than the step."""
    spec = harness.cell_files(harness.ROOT, "replica_room0", "seq")
    names = NEW + ["track_ms", "ba_ms.p95"]
    spec["per_layer"] = [{"name": n, "unit": "-"} for n in names]
    r = harness.run_cell("replica_room0.seq", 3, 2.0, True,
                         time.perf_counter(), device="cpu",
                         overrides=tiny.overrides("replica_room0"),
                         traffic_overrides=tiny.TRAFFIC,
                         sequence_overrides=tiny.SEQUENCE, spec=spec)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(names), set(names) - set(m)
    assert 0.0 < sum(m[n] for n in TRACK) <= m["track_ms"]
    assert 0.0 < sum(m[n] for n in BA) <= m["ba_ms.p95"]
    assert m["frame_block_ms"] > 0.0 and m["load_wait_ms"] >= 0.0
    assert m["first_frame_s"] > 0.0
