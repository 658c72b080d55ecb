"""The program's own spans, as the per-layer metrics read them from a
run's ``timings`` (coslam_torch's runtime/spans.py: one entry a call of
a step and of each of its phases, one a frame of the loop's load wait
and frame-block sum). A program that lacks a span has no key for it, and
its metric reads None."""

from typing import Callable, List, Optional


def mean_ms(run, key: str, frames: List[int],
            index: Callable[[int], int]) -> Optional[float]:
    """The mean over ``frames`` of ``timings[key][index(frame)]``, in
    ms; None without the key or the frames."""
    vals = run.timings.get(key)
    if not vals or not frames:
        return None
    return 1e3 * sum(vals[index(k)] for k in frames) / len(frames)


def tracking_ms(run, key: str) -> Optional[float]:
    """A tracking phase, mean a frame of the window before the traced
    stretch (aligned with timings["tracking"], as Run.track_s reads it)."""
    return mean_ms(run, key, run.frames(), lambda k: k - 1)


def ba_ms(run, key: str) -> Optional[float]:
    """A BA phase, mean a BA call of the window before the traced
    stretch (aligned with timings["mapping"], as Run.ba_s reads it)."""
    m = run.cfg["mapping"]["map_every"]
    return mean_ms(run, key, run.ba_frames(), lambda k: k // m - 1)


def frame_ms(run, key: str, frames: List[int]) -> Optional[float]:
    """A span with one entry a frame of the loop, mean over ``frames``."""
    return mean_ms(run, key, frames, lambda k: k)
