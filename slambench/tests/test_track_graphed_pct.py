"""track_graphed_pct on hand-made runs: None where the program has no
tracking.replay span, else the share of the window's tracking calls
before the traced stretch whose replay sum is above 0."""

import pytest

from slambench import harness
from slambench.tests.test_span_metrics import (CFG, EXCLUDED, K0, N, _run,
                                               _timings, _value)


def _replay_run(replayed):
    """A hand-made run whose tracking calls carry the tracking.replay sum:
    ``replayed(k)`` says whether frame k's call replayed the graph (its
    sum above 0) or ran eagerly (0)."""
    t = _timings(True)
    t["tracking.replay"] = [_value("tracking.replay", k) if replayed(k)
                            else 0.0 for k in range(1, N)]
    walls = [100.0 + 0.2 * k for k in range(N + 1)]
    return harness.Run(CFG, walls, t, [], K0, N, 3.0, EXCLUDED)


def test_track_graphed_pct_absent_reads_none():
    assert harness.reader("track_graphed_pct")(_run(True)) is None


@pytest.mark.parametrize("replayed, want", [
    (lambda k: False, 0.0),
    (lambda k: True, 100.0),
    # Frames 11-30 are the window before the stretch: 15 and 25 eager.
    (lambda k: k not in (15, 25), 90.0),
    # Set-up frames and the stretch are not counted.
    (lambda k: K0 <= k < 31, 100.0),
])
def test_track_graphed_pct_share_of_window_calls(replayed, want):
    run = _replay_run(replayed)
    assert harness.reader("track_graphed_pct")(run) == pytest.approx(
        want, rel=1e-12)
