"""The window's arithmetic: fps, frame_ms_p95, the frame phase and the
frames left out for the traced stretch."""

import pytest

from slambench import harness

CFG = {"mapping": {"map_every": 5, "keyframe_every": 5},
       "mesh": {"vis": 50}}


def _run(walls, k0=11, excluded=()):
    return harness.Run(CFG, walls, {"tracking": [], "mapping": [],
                                     "mesh": []}, [], k0, len(walls) - 1,
                       3.0, excluded)


def _walls(frame_s, stall_at=None, stall=0.0, n=120):
    walls, t = [], 100.0
    for k in range(n + 1):
        walls.append(t)
        t += frame_s + (stall if k == stall_at else 0.0)
    return walls


def test_one_stall_moves_fps_and_p95():
    """A window of 19 frames of 150 ms, one of them stalled by 1 s: fps
    falls and the 95th percentile (a tenth of the way from the second
    longest frame to the longest) rises, wherever the stall falls."""
    fps, p95 = harness.reader("fps"), harness.reader("frame_ms_p95")
    steady = _run(_walls(0.15, n=30))
    assert fps(steady) == pytest.approx(1 / 0.15)
    assert p95(steady) == pytest.approx(150.0)
    for k in (11, 20, 29):
        stalled = _run(_walls(0.15, stall_at=k, stall=1.0, n=30))
        assert fps(stalled) == pytest.approx(19 / (19 * 0.15 + 1.0))
        assert p95(stalled) == pytest.approx(150.0 + 0.1 * 1000.0)


def test_window_starts_after_the_first_ba_with_two_keyframes():
    assert harness.window_start(CFG) == 11
    cfg = {"mapping": {"map_every": 4, "keyframe_every": 8}}
    # BA at 4 sees keyframe 0, at 8 still only 0, at 12 frames 0 and 8.
    assert harness.window_start(cfg) == 13


def test_frames_leave_out_the_traced_stretch():
    run = _run(_walls(0.1, n=80), excluded=range(46, 57))
    assert run.frames(True) == list(range(11, 80))
    assert 46 not in run.frames() and 56 not in run.frames()
    assert len(run.frames()) == len(range(11, 80)) - 11


def test_sample_frames_lie_in_the_window_and_follow_the_seed():
    traffic = {"sample_span": 34, "track_samples": 4}
    a = harness.sample_frames(traffic, 11, CFG, 2 ** 31 + 5)
    b = harness.sample_frames(traffic, 11, CFG, 2 ** 31 + 5)
    c = harness.sample_frames(traffic, 11, CFG, 7)
    assert a == b and a != c
    tracks, ba = a
    assert len(tracks) == 4 and all(12 <= k < 45 for k in tracks)
    assert ba % 5 == 0 and 12 <= ba < 45
