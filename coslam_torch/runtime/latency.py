"""Frame-tail attribution: classify slow frames by overlapping events.

The port's own copy of coslam_tpu/runtime/latency.py (numpy). The frame
loops (runtime/slam.py, runtime/pipeline.py) record ``frame_walls`` (one
perf_counter per frame boundary) and ``frame_events`` (``(t_start,
t_end, tag)`` spans around checkpoint writes, BA calls, keyframe inserts,
mesh jobs and throttle waits). :func:`attribute_tails` turns the two into
a latency report: p50/p90/p99 frame times plus, for every frame slower
than ``slow_factor`` x p50, which event(s) overlapped it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def attribute_tails(frame_walls: Sequence[float],
                    frame_events: Sequence[Tuple[float, float, str]],
                    slow_factor: float = 2.0) -> Dict:
    """-> {p50/p90/p99/max ms, n_frames, n_slow, slow_by_cause,
    slow_untagged, mean_ms_by_cause}."""
    walls = np.asarray(frame_walls, np.float64)
    if len(walls) < 3:
        return {"n_frames": max(len(walls) - 1, 0)}
    dts = np.diff(walls)
    p50 = float(np.percentile(dts, 50))
    thresh = slow_factor * p50

    ev = sorted(frame_events)
    slow_by: Dict[str, int] = {}
    ms_by: Dict[str, List[float]] = {}
    untagged = 0
    # Work queued on the card inside an event's span shows as wall time
    # wherever the host next waits for it (a readback a frame or two
    # later), so an event up to three median frames back still counts.
    lookback = 3 * p50
    for k in np.nonzero(dts > thresh)[0]:
        t0, t1 = walls[k], walls[k + 1]
        tags = sorted({tag for (e0, e1, tag) in ev
                       if e0 < t1 and e1 > t0 - lookback})
        if not tags:
            untagged += 1
            ms_by.setdefault("untagged", []).append(dts[k] * 1e3)
            continue
        key = "+".join(tags)
        slow_by[key] = slow_by.get(key, 0) + 1
        ms_by.setdefault(key, []).append(dts[k] * 1e3)

    return {
        "n_frames": int(len(dts)),
        "p50_ms": round(p50 * 1e3, 2),
        "p90_ms": round(float(np.percentile(dts, 90)) * 1e3, 2),
        "p99_ms": round(float(np.percentile(dts, 99)) * 1e3, 2),
        "max_ms": round(float(dts.max()) * 1e3, 2),
        "slow_threshold_ms": round(thresh * 1e3, 2),
        "n_slow": int((dts > thresh).sum()),
        "slow_by_cause": slow_by,
        "slow_untagged": int(untagged),
        "mean_ms_by_cause": {k: round(float(np.mean(v)), 1)
                             for k, v in ms_by.items()},
    }
